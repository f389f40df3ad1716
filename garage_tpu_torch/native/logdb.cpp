// logdb — native log-structured metadata engine (the default engine slot).
//
// Role equivalent of the reference's LMDB adapter (ref db/lmdb_adapter.rs:
// 1-354): the fast native engine behind the Db/Tree/Transaction facade.
// It depends on no LMDB library: this is an original bitcask-style
// design with the properties the metadata layer needs:
//
//   - append-only log file; every mutation group ends with a COMMIT
//     record, so a torn write never exposes a partial transaction
//     (recovery truncates to the last committed group);
//   - CRC32-protected records;
//   - in-RAM ordered index per tree: key -> (file offset, length) of the
//     live value; values are pread() on demand (RAM holds keys only);
//   - ordered range iteration with snapshot-of-keys semantics (same
//     contract as the other engines' adapters);
//   - automatic compaction when dead bytes dominate.
//
// Exposed as a C ABI consumed by db/native_adapter.py over ctypes.

#include <algorithm>
#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <mutex>
#include <string>
#include <vector>

#include <fcntl.h>
#include <unistd.h>
#include <sys/stat.h>

namespace {

constexpr char MAGIC[8] = {'G','T','L','O','G','D','B','1'};
constexpr uint8_t OP_PUT = 1;
constexpr uint8_t OP_DEL = 2;
constexpr uint8_t OP_COMMIT = 3;
constexpr uint8_t OP_TREEDEF = 4;
constexpr uint8_t OP_CLEAR = 5;

// CRC-32 (IEEE, reflected) — table-driven
uint32_t crc_table[256];
struct CrcInit {
    CrcInit() {
        for (uint32_t i = 0; i < 256; i++) {
            uint32_t c = i;
            for (int k = 0; k < 8; k++)
                c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
            crc_table[i] = c;
        }
    }
} crc_init;

uint32_t crc32(const uint8_t* p, size_t n, uint32_t crc = 0) {
    crc = ~crc;
    while (n--) crc = crc_table[(crc ^ *p++) & 0xFF] ^ (crc >> 8);
    return ~crc;
}

void put_u32(std::string& s, uint32_t v) {
    char b[4] = {(char)(v), (char)(v >> 8), (char)(v >> 16), (char)(v >> 24)};
    s.append(b, 4);
}

uint32_t get_u32(const uint8_t* p) {
    return (uint32_t)p[0] | ((uint32_t)p[1] << 8) |
           ((uint32_t)p[2] << 16) | ((uint32_t)p[3] << 24);
}

struct Loc { uint64_t off; uint32_t len; };

struct Tree {
    std::string name;
    std::map<std::string, Loc> index;
};

struct LogDb {
    int fd = -1;
    std::string path;
    uint64_t file_size = 0;      // logical end (committed + pending appended)
    uint64_t live_bytes = 0;     // bytes of live values (compaction heuristic)
    std::vector<Tree> trees;
    std::mutex mu;
    std::string err;
    bool fsync_commits = false;
    bool broken = false;   // unrecoverable append failure: refuse writes

    int tree_by_name(const std::string& n) {
        for (size_t i = 0; i < trees.size(); i++)
            if (trees[i].name == n) return (int)i;
        return -1;
    }
};

struct Iter {
    LogDb* db;
    int tree;
    std::vector<std::string> keys;  // snapshot of the range
    size_t pos = 0;
    std::string cur_key, cur_val;
};

// serialize one record into out; returns offset-of-value within record
size_t append_record(std::string& out, uint8_t type, uint32_t tree,
                     const uint8_t* k, uint32_t klen,
                     const uint8_t* v, uint32_t vlen) {
    std::string body;
    body.push_back((char)type);
    put_u32(body, tree);
    put_u32(body, klen);
    put_u32(body, vlen);
    if (klen) body.append((const char*)k, klen);
    size_t val_off_in_body = body.size();
    if (vlen) body.append((const char*)v, vlen);
    uint32_t crc = crc32((const uint8_t*)body.data(), body.size());
    put_u32(out, crc);
    out.append(body);
    return 4 + val_off_in_body;  // +4 for the crc prefix
}

bool write_all(int fd, const void* buf, size_t n) {
    const char* p = (const char*)buf;
    while (n) {
        ssize_t w = ::write(fd, p, n);
        if (w < 0) { if (errno == EINTR) continue; return false; }
        p += w; n -= (size_t)w;
    }
    return true;
}

// Replay the log, building indexes. Returns the offset of the end of the
// last committed group (file is truncated there if shorter than size).
bool replay(LogDb* db) {
    struct stat st;
    if (fstat(db->fd, &st) != 0) { db->err = "fstat failed"; return false; }
    uint64_t size = (uint64_t)st.st_size;
    if (size < 8) {
        // torn initial write (1-7 byte file): reset before re-writing the
        // magic — fd is O_APPEND, a bare write would land past the tear
        if (size > 0 && ftruncate(db->fd, 0) != 0) {
            db->err = "truncate torn header";
            return false;
        }
        if (!write_all(db->fd, MAGIC, 8)) { db->err = "write magic"; return false; }
        db->file_size = 8;
        return true;
    }
    char magic[8];
    if (pread(db->fd, magic, 8, 0) != 8 || memcmp(magic, MAGIC, 8) != 0) {
        db->err = "bad magic";
        return false;
    }

    // pending (uncommitted) group: list of (type, tree, key, val_loc)
    struct Pending { uint8_t type; uint32_t tree; std::string key; Loc loc; };
    std::vector<Pending> pending;
    std::vector<std::pair<uint32_t, std::string>> pending_trees;

    uint64_t off = 8, committed_end = 8;
    std::vector<uint8_t> buf;
    while (off + 17 <= size) {
        uint8_t hdr[17];
        if (pread(db->fd, hdr, 17, (off_t)off) != 17) break;
        uint32_t crc = get_u32(hdr);
        uint8_t type = hdr[4];
        uint32_t tree = get_u32(hdr + 5);
        uint32_t klen = get_u32(hdr + 9);
        uint32_t vlen = get_u32(hdr + 13);
        uint64_t rec_len = 17ull + klen + vlen;
        if (off + rec_len > size || klen > (64u << 20) || vlen > (256u << 20))
            break;
        buf.resize(13 + klen + vlen);
        if (pread(db->fd, buf.data() + 13, klen + vlen, (off_t)(off + 17))
            != (ssize_t)(klen + vlen)) break;
        memcpy(buf.data(), hdr + 4, 13);
        if (crc32(buf.data(), buf.size()) != crc) break;

        const char* kp = (const char*)buf.data() + 13;
        switch (type) {
        case OP_PUT:
            pending.push_back({type, tree, std::string(kp, klen),
                               {off + 17 + klen, vlen}});
            break;
        case OP_DEL:
            pending.push_back({type, tree, std::string(kp, klen), {0, 0}});
            break;
        case OP_CLEAR:
            pending.push_back({type, tree, std::string(), {0, 0}});
            break;
        case OP_TREEDEF:
            pending_trees.push_back({tree, std::string(kp, klen)});
            break;
        case OP_COMMIT: {
            for (auto& pt : pending_trees) {
                while (db->trees.size() <= pt.first)
                    db->trees.push_back(Tree{});
                db->trees[pt.first].name = pt.second;
            }
            pending_trees.clear();
            for (auto& p : pending) {
                if (p.tree >= db->trees.size()) continue;  // corrupt ref
                auto& idx = db->trees[p.tree].index;
                if (p.type == OP_PUT) {
                    auto it = idx.find(p.key);
                    if (it != idx.end()) db->live_bytes -= it->second.len;
                    idx[p.key] = p.loc;
                    db->live_bytes += p.loc.len;
                } else if (p.type == OP_DEL) {
                    auto it = idx.find(p.key);
                    if (it != idx.end()) {
                        db->live_bytes -= it->second.len;
                        idx.erase(it);
                    }
                } else if (p.type == OP_CLEAR) {
                    for (auto& kv : idx) db->live_bytes -= kv.second.len;
                    idx.clear();
                }
            }
            pending.clear();
            committed_end = off + rec_len;
            break;
        }
        default:
            goto done;  // unknown type: stop (future format)
        }
        off += rec_len;
    }
done:
    db->file_size = committed_end;
    if (committed_end < size) {
        if (ftruncate(db->fd, (off_t)committed_end) != 0) {
            db->err = "truncate failed";
            return false;
        }
    }
    if (lseek(db->fd, (off_t)committed_end, SEEK_SET) < 0) {
        db->err = "seek failed";
        return false;
    }
    return true;
}

// append a group (records already serialized, commit included); updates
// file_size; group offsets in locs were pre-computed relative to start
bool append_group(LogDb* db, const std::string& group) {
    if (!write_all(db->fd, group.data(), group.size())) {
        // a partial append left bytes past the committed end; truncate
        // back so O_APPEND keeps physical EOF == logical file_size (value
        // offsets of later commits depend on it).  If even that fails the
        // handle is poisoned: every later write would corrupt offsets.
        if (ftruncate(db->fd, (off_t)db->file_size) != 0)
            db->broken = true;
        db->err = "append failed";
        return false;
    }
    db->file_size += group.size();
    if (db->fsync_commits) fdatasync(db->fd);
    return true;
}

// Rewrite only live records into a fresh log and atomically replace the
// old file; indexes are rebuilt by replaying the new file (replay is the
// single source of truth for offsets).
bool compact(LogDb* db) {
    std::string tmp = db->path + ".compact";
    int nfd = ::open(tmp.c_str(), O_WRONLY | O_CREAT | O_TRUNC, 0644);
    if (nfd < 0) return false;
    std::string out(MAGIC, 8);
    std::string val;
    for (uint32_t t = 0; t < db->trees.size(); t++)
        append_record(out, OP_TREEDEF, t,
                      (const uint8_t*)db->trees[t].name.data(),
                      (uint32_t)db->trees[t].name.size(), nullptr, 0);
    for (uint32_t t = 0; t < db->trees.size(); t++) {
        for (auto& kv : db->trees[t].index) {
            val.resize(kv.second.len);
            if (kv.second.len &&
                pread(db->fd, &val[0], kv.second.len, (off_t)kv.second.off)
                    != (ssize_t)kv.second.len) {
                ::close(nfd); ::unlink(tmp.c_str()); return false;
            }
            append_record(out, OP_PUT, t, (const uint8_t*)kv.first.data(),
                          (uint32_t)kv.first.size(),
                          (const uint8_t*)val.data(), (uint32_t)val.size());
            if (out.size() > (8u << 20)) {  // keep the staging buffer bounded
                if (!write_all(nfd, out.data(), out.size())) {
                    ::close(nfd); ::unlink(tmp.c_str()); return false;
                }
                out.clear();
            }
        }
    }
    append_record(out, OP_COMMIT, 0, nullptr, 0, nullptr, 0);
    if (!write_all(nfd, out.data(), out.size())) {
        ::close(nfd); ::unlink(tmp.c_str()); return false;
    }
    fdatasync(nfd);
    ::close(nfd);
    if (rename(tmp.c_str(), db->path.c_str()) != 0) {
        ::unlink(tmp.c_str());
        return false;
    }
    ::close(db->fd);
    db->fd = ::open(db->path.c_str(), O_RDWR | O_APPEND, 0644);
    if (db->fd < 0) return false;
    db->trees.clear();
    db->live_bytes = 0;
    db->file_size = 0;
    return replay(db);
}

}  // namespace

extern "C" {

LogDb* ldb_open(const char* path, int fsync_commits) {
    LogDb* db = new LogDb();
    db->path = path;
    db->fsync_commits = fsync_commits != 0;
    db->fd = ::open(path, O_RDWR | O_CREAT | O_APPEND, 0644);
    if (db->fd < 0) { delete db; return nullptr; }
    if (!replay(db)) { ::close(db->fd); delete db; return nullptr; }
    // startup compaction when the log is dominated by dead records
    struct stat st;
    if (fstat(db->fd, &st) == 0 && (uint64_t)st.st_size > (4u << 20) &&
        (uint64_t)st.st_size > 4 * (db->live_bytes + (16u << 10)))
        compact(db);
    return db;
}

int ldb_open_tree(LogDb* db, const char* name, uint32_t namelen) {
    std::lock_guard<std::mutex> g(db->mu);
    std::string n(name, namelen);
    int i = db->tree_by_name(n);
    if (i >= 0) return i;
    uint32_t idx = (uint32_t)db->trees.size();
    std::string group;
    append_record(group, OP_TREEDEF, idx, (const uint8_t*)n.data(),
                  (uint32_t)n.size(), nullptr, 0);
    append_record(group, OP_COMMIT, 0, nullptr, 0, nullptr, 0);
    if (!append_group(db, group)) return -1;
    db->trees.push_back(Tree{n, {}});
    return (int)idx;
}

int ldb_tree_count(LogDb* db) {
    std::lock_guard<std::mutex> g(db->mu);
    return (int)db->trees.size();
}

// copies the name into out (cap bytes); returns the name length
int ldb_tree_name(LogDb* db, int tree, char* out, uint32_t cap) {
    std::lock_guard<std::mutex> g(db->mu);
    if (tree < 0 || (size_t)tree >= db->trees.size()) return -1;
    const std::string& n = db->trees[tree].name;
    if (n.size() <= cap) memcpy(out, n.data(), n.size());
    return (int)n.size();
}

// returns value length, -1 if absent, -2 on error; value copied into out
// if it fits cap (call twice: probe with cap=0 then read)
long ldb_get(LogDb* db, int tree, const uint8_t* key, uint32_t klen,
             uint8_t* out, uint32_t cap) {
    std::lock_guard<std::mutex> g(db->mu);
    if (tree < 0 || (size_t)tree >= db->trees.size()) return -2;
    auto& idx = db->trees[tree].index;
    auto it = idx.find(std::string((const char*)key, klen));
    if (it == idx.end()) return -1;
    if (it->second.len <= cap && it->second.len > 0) {
        if (pread(db->fd, out, it->second.len, (off_t)it->second.off)
            != (ssize_t)it->second.len)
            return -2;
    }
    return (long)it->second.len;
}

long ldb_len(LogDb* db, int tree) {
    std::lock_guard<std::mutex> g(db->mu);
    if (tree < 0 || (size_t)tree >= db->trees.size()) return -1;
    return (long)db->trees[tree].index.size();
}

// Apply a batch of operations atomically (one commit record).
// ops buffer: repeated [u8 op(1=put,2=del,5=clear), u32 tree, u32 klen,
// u32 vlen, key, val].  Returns 0 on success.
int ldb_apply(LogDb* db, const uint8_t* ops, uint64_t ops_len) {
    std::lock_guard<std::mutex> g(db->mu);
    if (db->broken) return -3;
    std::string group;
    struct Staged { uint8_t op; uint32_t tree; std::string key; uint64_t voff; uint32_t vlen; };
    std::vector<Staged> staged;
    uint64_t base = db->file_size;
    uint64_t p = 0;
    while (p + 13 <= ops_len) {
        uint8_t op = ops[p];
        uint32_t tree = get_u32(ops + p + 1);
        uint32_t klen = get_u32(ops + p + 5);
        uint32_t vlen = get_u32(ops + p + 9);
        if (p + 13 + klen + vlen > ops_len) return -1;
        if (tree >= db->trees.size()) return -1;
        const uint8_t* k = ops + p + 13;
        const uint8_t* v = k + klen;
        uint8_t rec_type = op == 5 ? OP_CLEAR : (op == 2 ? OP_DEL : OP_PUT);
        uint64_t rec_start = group.size();
        append_record(group, rec_type, tree, k, klen,
                      op == 1 ? v : nullptr, op == 1 ? vlen : 0);
        // record layout: crc(4) type(1) tree(4) klen(4) vlen(4) key val
        staged.push_back({op, tree, std::string((const char*)k, klen),
                          base + rec_start + 17 + klen, op == 1 ? vlen : 0});
        p += 13ull + klen + vlen;
    }
    if (p != ops_len) return -1;
    append_record(group, OP_COMMIT, 0, nullptr, 0, nullptr, 0);
    if (!append_group(db, group)) return -2;
    for (auto& s : staged) {
        auto& idx = db->trees[s.tree].index;
        if (s.op == 1) {
            auto it = idx.find(s.key);
            if (it != idx.end()) db->live_bytes -= it->second.len;
            idx[s.key] = {s.voff, s.vlen};
            db->live_bytes += s.vlen;
        } else if (s.op == 2) {
            auto it = idx.find(s.key);
            if (it != idx.end()) { db->live_bytes -= it->second.len; idx.erase(it); }
        } else if (s.op == 5) {
            for (auto& kv : idx) db->live_bytes -= kv.second.len;
            idx.clear();
        }
    }
    // runtime compaction: reclaim space once dead records dominate (the
    // open-time check alone would let a long-running daemon's log grow
    // without bound).  Amortized: cost is O(live bytes), triggered only
    // after ≥4× that much has been written.
    if (db->file_size > (4u << 20) &&
        db->file_size > 4 * (db->live_bytes + (16u << 10)))
        compact(db);
    return 0;
}

Iter* ldb_iter_new(LogDb* db, int tree, const uint8_t* start, uint32_t slen,
                   int has_start, const uint8_t* end, uint32_t elen,
                   int has_end, int reverse) {
    std::lock_guard<std::mutex> g(db->mu);
    if (tree < 0 || (size_t)tree >= db->trees.size()) return nullptr;
    Iter* it = new Iter();
    it->db = db;
    it->tree = tree;
    auto& idx = db->trees[tree].index;
    auto lo = has_start ? idx.lower_bound(std::string((const char*)start, slen))
                        : idx.begin();
    auto hi = has_end ? idx.lower_bound(std::string((const char*)end, elen))
                      : idx.end();
    for (auto i = lo; i != hi; ++i) it->keys.push_back(i->first);
    if (reverse) std::reverse(it->keys.begin(), it->keys.end());
    return it;
}

// advances; returns 1 and fills pointers (valid until next call/free),
// 0 at end, -1 on error.  Keys deleted since the snapshot are skipped.
int ldb_iter_next(Iter* it, const uint8_t** k, uint32_t* klen,
                  const uint8_t** v, uint32_t* vlen) {
    LogDb* db = it->db;
    std::lock_guard<std::mutex> g(db->mu);
    auto& idx = db->trees[it->tree].index;
    while (it->pos < it->keys.size()) {
        const std::string& key = it->keys[it->pos++];
        auto f = idx.find(key);
        if (f == idx.end()) continue;  // deleted since snapshot
        it->cur_key = key;
        it->cur_val.resize(f->second.len);
        if (f->second.len &&
            pread(db->fd, &it->cur_val[0], f->second.len,
                  (off_t)f->second.off) != (ssize_t)f->second.len)
            return -1;
        *k = (const uint8_t*)it->cur_key.data();
        *klen = (uint32_t)it->cur_key.size();
        *v = (const uint8_t*)it->cur_val.data();
        *vlen = (uint32_t)it->cur_val.size();
        return 1;
    }
    return 0;
}

void ldb_iter_free(Iter* it) { delete it; }

int ldb_sync(LogDb* db) {
    std::lock_guard<std::mutex> g(db->mu);
    return fdatasync(db->fd) == 0 ? 0 : -1;
}


int ldb_compact(LogDb* db) {
    std::lock_guard<std::mutex> g(db->mu);
    return compact(db) ? 0 : -1;
}

// flush + fsync + copy the log to `dest`
int ldb_snapshot(LogDb* db, const char* dest) {
    std::lock_guard<std::mutex> g(db->mu);
    if (fdatasync(db->fd) != 0) return -1;
    int out = ::open(dest, O_WRONLY | O_CREAT | O_TRUNC, 0644);
    if (out < 0) return -1;
    uint64_t off = 0;
    char buf[1 << 16];
    while (off < db->file_size) {
        size_t want = (size_t)std::min<uint64_t>(sizeof buf, db->file_size - off);
        ssize_t r = pread(db->fd, buf, want, (off_t)off);
        if (r <= 0) { ::close(out); return -1; }
        if (!write_all(out, buf, (size_t)r)) { ::close(out); return -1; }
        off += (uint64_t)r;
    }
    fdatasync(out);
    ::close(out);
    return 0;
}

void ldb_close(LogDb* db) {
    if (db->fd >= 0) { fdatasync(db->fd); ::close(db->fd); }
    delete db;
}

const char* ldb_error(LogDb* db) { return db->err.c_str(); }

}  // extern "C"
